from repro_torch.core.clustering.api import (
    DEVICE_META_KEYS,
    DeviceClusteringResult,
    DeviceLloydFamily,
    device_meta,
    get_algorithm,
    is_device_algorithm,
    list_algorithms,
    meta_to_host,
    register_algorithm,
    resolve_device_request,
    unregister_algorithm,
)
from repro_torch.core.clustering.kmeans import (
    kmeans_plus_plus_init,
    random_init,
)

__all__ = [
    "DEVICE_META_KEYS",
    "DeviceClusteringResult",
    "DeviceLloydFamily",
    "device_meta",
    "get_algorithm",
    "is_device_algorithm",
    "kmeans_plus_plus_init",
    "list_algorithms",
    "meta_to_host",
    "random_init",
    "register_algorithm",
    "resolve_device_request",
    "unregister_algorithm",
]
