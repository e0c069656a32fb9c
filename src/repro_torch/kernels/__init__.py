"""Hand-written CUDA kernels of the K-FAC path and their wrappers.

Each wrapper takes its plain PyTorch version (``*_ref``) only for CPU
tensors; for CUDA tensors it launches its kernel or raises.  Each carries a
``launches`` counter, a plain int that grows by one per kernel launch
(``precondition`` and ``ns_step`` count their own calls on the card; the
``matmul`` launches they make count on ``matmul`` as well).
"""
from repro_torch.kernels import factor_update as _factor_update
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import ns_step as _ns_step
from repro_torch.kernels import precond as _precond

WRAPPERS = {"matmul": _matmul.matmul,
            "factor_update": _factor_update.factor_update,
            "precondition": _precond.precondition,
            "ns_step": _ns_step.ns_step}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
