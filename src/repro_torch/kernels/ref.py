"""Plain PyTorch oracles for the kernels (allclose targets in tests)."""

from __future__ import annotations

import torch

from repro_torch.core import epilogue as epilogue_mod


def matmul_epilogue_ref(a: torch.Tensor, b: torch.Tensor, *, bias=None,
                        residual=None, epilogue=None,
                        out_dtype=None) -> torch.Tensor:
    """Oracle for the fused-epilogue matmul:
    out = act(scale * (A@B) + bias) + residual, applied at fp32 through the
    shared op table, then one cast.  Supports leading batch dims on `a`."""
    ep = epilogue_mod.Epilogue.parse(epilogue, bias=bias, residual=residual)
    z = torch.matmul(a.float(), b.float())
    z = epilogue_mod.apply_spec(z, ep.spec, ep.operands())
    return z.to(out_dtype or a.dtype)


def grouped_matmul_ref(a: torch.Tensor, b: torch.Tensor, *, residual=None,
                       epilogue=None, out_dtype=None) -> torch.Tensor:
    """Oracle for the grouped (per-group rhs) matmul:
    C[g] = epilogue(A[g] @ B[g]), fp32 accumulation, one cast at the end."""
    ep = epilogue_mod.Epilogue.parse(epilogue, residual=residual)
    z = torch.bmm(a.float(), b.float())
    z = epilogue_mod.apply_spec(z, ep.spec, ep.operands())
    return z.to(out_dtype or a.dtype)
