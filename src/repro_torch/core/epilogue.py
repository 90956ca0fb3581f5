"""Structured fused-epilogue spec for the planned matmul.

Semantics (all at fp32 accumulator width, one cast at the end):

    out = act(scale * (A @ B) + bias) + residual

The op vocabulary lives in ONE table (`EPILOGUE_OPS`, applied in that
order), shared by the "torch" backend, the kernels' plain versions and the
oracle; the CUDA kernels encode the same order.  `gelu` is the tanh
approximation, as `jax.nn.gelu` defaults to (``F.gelu`` defaults to erf).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

# name -> (needs_value, fn(z, value)), in application order.
EPILOGUE_OPS: dict[str, tuple[bool, Any]] = {
    "scale": (True, lambda z, v: z * v),
    "bias": (True, lambda z, v: z + v),
    "gelu": (False, lambda z, v: F.gelu(z, approximate="tanh")),
    "silu": (False, lambda z, v: F.silu(z)),
    "residual": (True, lambda z, v: z + v),
}

EPILOGUE_TOKENS = tuple(EPILOGUE_OPS)
ACTIVATIONS = ("gelu", "silu")

# Ops whose value is a static python scalar rather than a tensor operand.
_STATIC_OPS = ("scale",)


def _validate_tokens(tokens: tuple[str, ...], label: str) -> None:
    bad = [t for t in tokens if t not in EPILOGUE_OPS]
    if bad or len(set(tokens)) != len(tokens):
        raise ValueError(f"bad epilogue spec {label!r}; tokens must be "
                         f"unique and from {EPILOGUE_TOKENS}")
    if sum(t in ACTIVATIONS for t in tokens) > 1:
        raise ValueError(f"epilogue {label!r} names two activations")


@dataclasses.dataclass(frozen=True, eq=False)
class Epilogue:
    """A fused epilogue with its operands attached.

    `bias` is a (n,) vector, `residual` broadcast-matches the output,
    `scale` is a static python scalar, `act` one of ACTIVATIONS.  An op is
    named iff its field is set.
    """

    act: str | None = None
    scale: float | None = None
    bias: torch.Tensor | None = None
    residual: torch.Tensor | None = None

    def __post_init__(self):
        if self.act is not None and self.act not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.act!r}; "
                             f"must be one of {ACTIVATIONS}")
        if self.scale is not None:
            object.__setattr__(self, "scale", float(self.scale))

    @property
    def tokens(self) -> tuple[str, ...]:
        """Named ops in application order."""
        out = []
        for name in EPILOGUE_OPS:
            if name in ACTIVATIONS:
                if self.act == name:
                    out.append(name)
            elif getattr(self, name) is not None:
                out.append(name)
        return tuple(out)

    @property
    def spec(self) -> tuple[tuple[str, float | None], ...]:
        """Hashable description: ((token, static_value), ...)."""
        return tuple((t, self.scale if t in _STATIC_OPS else None)
                     for t in self.tokens)

    def __bool__(self) -> bool:
        return bool(self.tokens)

    def operands(self) -> dict[str, torch.Tensor]:
        """Tensor operands keyed by op name."""
        out = {}
        if self.bias is not None:
            out["bias"] = self.bias
        if self.residual is not None:
            out["residual"] = self.residual
        return out

    def replace(self, **kw) -> "Epilogue":
        return dataclasses.replace(self, **kw)

    @classmethod
    def parse(cls, spec: "Epilogue | str | None", *, bias=None,
              residual=None, scale=None) -> "Epilogue":
        """Accept an Epilogue, a token string ("bias_gelu", ...) or None.
        Naming an op without passing its operand raises ValueError."""
        if isinstance(spec, Epilogue):
            return spec
        if not spec or spec == "none":
            return cls()
        if not isinstance(spec, str):
            raise TypeError(f"epilogue must be an Epilogue, a token string "
                            f"or None, got {type(spec).__name__}")
        tokens = tuple(spec.split("_"))
        _validate_tokens(tokens, spec)
        kw: dict[str, Any] = {}
        for t in tokens:
            if t in ACTIVATIONS:
                kw["act"] = t
                continue
            value = {"bias": bias, "residual": residual,
                     "scale": scale}[t]
            if value is None:
                raise ValueError(
                    f"epilogue names {t!r} but none was passed")
            kw[t] = value
        return cls(**kw)


def normalize_spec(epilogue) -> tuple[tuple[str, float | None], ...]:
    """Kernel-side static-spec normalization (spec tuple, token string or
    None)."""
    if epilogue is None or epilogue == "none" or epilogue == ():
        return ()
    if isinstance(epilogue, str):
        tokens = tuple(epilogue.split("_"))
        _validate_tokens(tokens, epilogue)
        return tuple((t, None) for t in tokens)
    tokens = tuple(t for t, _ in epilogue)
    _validate_tokens(tokens, str(tokens))
    return tuple(epilogue)


def apply_spec(z: torch.Tensor, spec, operands: dict[str, Any]):
    """Apply a normalized spec to the fp32 accumulator value `z`; tensor
    operands are cast to fp32 here."""
    for token, static in normalize_spec(spec):
        needs_value, fn = EPILOGUE_OPS[token]
        value = static
        if needs_value and value is None:
            value = operands[token]
            if isinstance(value, torch.Tensor):
                value = value.float()
        z = fn(z, value)
    return z
