"""Hand-written CUDA kernels of the K-FAC and serving paths (decode and
prefill attention, the conv stem's patch factors) and their wrappers.

Each wrapper takes its plain PyTorch version (``*_ref``) only for CPU
tensors; for CUDA tensors it launches its kernel or raises.  Each carries a
``launches`` counter, a plain int that grows by one per kernel launch
(``precondition``, ``ns_step``, ``rotate_rescale`` and ``precond_momentum``
count their own calls on the card; the ``matmul``, ``matmul_rescale`` and
``axpy_momentum`` launches they make count on those wrappers as well).
"""
from repro_torch.kernels import factor_update as _factor_update
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import flash_decode as _flash_decode
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import ns_step as _ns_step
from repro_torch.kernels import patch_factor as _patch_factor
from repro_torch.kernels import precond as _precond
from repro_torch.kernels import rotate_rescale as _rotate_rescale
from repro_torch.kernels import update_chain as _update_chain

WRAPPERS = {"matmul": _matmul.matmul,
            "factor_update": _factor_update.factor_update,
            "precondition": _precond.precondition,
            "ns_step": _ns_step.ns_step,
            "matmul_rescale": _rotate_rescale.matmul_rescale,
            "rotate_rescale": _rotate_rescale.rotate_rescale,
            "axpy_momentum": _update_chain.axpy_momentum,
            "precond_momentum": _update_chain.precond_momentum,
            "flash_decode": _flash_decode.flash_decode,
            "flash_decode_paged": _flash_decode.flash_decode_paged,
            "flash_attention": _flash_attention.flash_attention,
            "patch_factor": _patch_factor.patch_factor_update}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
