"""The paper's contribution, the ODCL-C one-shot framework, in PyTorch
(the port of ``repro/core``, with its public names).

Two plug-in layers sit at the centre:

  clustering/api.py  the admissible set C as a registry: the
                     ``ClusteringAlgorithm`` protocol (``ClusteringResult``
                     out, the Lemma-1/2 ``admissibility_alpha``), with
                     kmeans / kmeans++ / spectral / gradient / convex /
                     clusterpath and their device twins registered;
  methods.py         ``Method.fit(key, xs, ys, erm) -> MethodResult``:
                     ``ODCL`` over any registered algorithm, ``IFCA``,
                     ``GlobalERM``, ``LocalOnly``, ``OracleAveraging``,
                     ``ClusterOracle``.

Around them: ``odcl.py`` (Algorithm 1's steps), ``erm.py`` (the local
solvers), ``ifca.py``, ``oracles.py``, ``theory.py`` (Table 1 and
Theorem 1), ``sketch.py`` (the JL sketch), ``federated.py`` (the LM-scale
round) and ``federated_methods.py`` (the LM-scale methods, whose names
load lazily: that module pulls in the model and launch stack, which
light users of this package must not pay for).
"""
from repro_torch.core.odcl import (
    ODCLResult,
    aggregate,
    odcl,
    run_clustering,
)
from repro_torch.core.erm import (
    batched_logistic_erm,
    batched_ridge_erm,
    logistic_erm,
    ridge_erm,
    sgd_erm,
)
from repro_torch.core.ifca import (
    IFCAConfig,
    ifca,
    ifca_init_annulus,
    ifca_init_near_optima,
)
from repro_torch.core import oracles, theory
from repro_torch.core.sketch import sketch_tree, sketch_vector
from repro_torch.core.clustering.api import (
    ClusteringAlgorithm,
    ClusteringResult,
    DeviceClusteringAlgorithm,
    DeviceClusteringResult,
    get_algorithm,
    is_device_algorithm,
    list_algorithms,
    register_algorithm,
    unregister_algorithm,
)
from repro_torch.core.methods import (
    IFCA,
    ODCL,
    ClusterOracle,
    GlobalERM,
    LocalOnly,
    Method,
    MethodResult,
    OracleAveraging,
    get_method,
    list_methods,
    register_method,
)

__all__ = [
    "ODCLResult",
    "odcl",
    "aggregate",
    "run_clustering",
    "ridge_erm",
    "batched_ridge_erm",
    "logistic_erm",
    "batched_logistic_erm",
    "sgd_erm",
    "IFCAConfig",
    "ifca",
    "ifca_init_near_optima",
    "ifca_init_annulus",
    "oracles",
    "theory",
    "sketch_vector",
    "sketch_tree",
    "ClusteringAlgorithm",
    "ClusteringResult",
    "DeviceClusteringAlgorithm",
    "DeviceClusteringResult",
    "get_algorithm",
    "is_device_algorithm",
    "list_algorithms",
    "register_algorithm",
    "unregister_algorithm",
    "Method",
    "MethodResult",
    "ODCL",
    "IFCA",
    "GlobalERM",
    "LocalOnly",
    "OracleAveraging",
    "ClusterOracle",
    "get_method",
    "list_methods",
    "register_method",
]

_FEDERATED_METHOD_EXPORTS = (
    "FederatedMethod",
    "FederatedMethodResult",
    "ODCLFederated",
    "IFCAFederated",
    "FedAvgGlobal",
    "LocalOnlyFederated",
    "register_federated_method",
    "unregister_federated_method",
    "get_federated_method",
    "list_federated_methods",
    "build_federated_method",
    "cluster_agreement",
    "params_bytes_per_client",
)
__all__ += list(_FEDERATED_METHOD_EXPORTS)


def __getattr__(name):
    if name in _FEDERATED_METHOD_EXPORTS:
        from repro_torch.core import federated_methods

        return getattr(federated_methods, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
