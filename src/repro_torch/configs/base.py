"""Configuration system of the PyTorch port (the dense family's part of
``repro.configs.base``).

Every architecture is expressed as a ``ModelConfig``. The config fully
determines the parameter tree and the decode semantics; ``reduced()``
produces the CPU-smoke variant of the same family. The port serves the
dense family, so the config carries only the dense family's fields;
``get_config`` refuses the other architectures of the JAX package with
the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"         # dense | moe | hybrid | audio | vlm | ssm
    source: str = ""              # citation for the config
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 512
    eos_id: int = 2               # end-of-sequence id the serving loops stop on
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    # sliding-window pattern: window size (0 = full attention) and the
    # local:global pattern period (gemma3: 5 local then 1 global)
    sliding_window: int = 0
    global_every: int = 0         # 0 = all layers same; k>0: layer is global
                                  # iff (idx % k == k-1)
    # norms / residual structure / embeddings
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    parallel_residual: bool = False   # stablelm-2 style attn+FFN in parallel
    tie_embeddings: bool = False
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    sub_quadratic: bool = False   # eligible for long_500k (shape table)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (<=2 layers,
        d_model<=128), as the JAX package reduces the dense family."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=4,
            n_kv_heads=min(max(1, self.n_kv_heads), 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32,
        )
        if self.global_every:
            kw["global_every"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 8
        return replace(self, **kw)


# the dense configs of the JAX package
ARCH_IDS = ["opt-1.3b", "granite-3-8b", "gemma3-1b", "hundred-m",
            "qwen1.5-107b", "phi3-medium-14b", "stablelm-12b"]

_MODULE_FOR = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
               for a in ARCH_IDS}

# every architecture of the JAX package, in its order (the dry-run's
# matrix)
JAX_ARCH_IDS = [
    "granite-3-8b", "deepseek-v2-236b", "arctic-480b", "stablelm-12b",
    "phi3-medium-14b", "zamba2-1.2b", "seamless-m4t-large-v2",
    "qwen2-vl-7b", "xlstm-1.3b", "gemma3-1b",
    # the paper's own models
    "opt-1.3b", "qwen1.5-107b",
]

# architectures of the JAX package that the port does not carry yet: the
# non-dense families (A.16)
_NOT_PORTED = {
    "deepseek-v2-236b": "A.16", "arctic-480b": "A.16", "zamba2-1.2b": "A.16",
    "seamless-m4t-large-v2": "A.16", "qwen2-vl-7b": "A.16",
    "xlstm-1.3b": "A.16",
}


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP {_NOT_PORTED[arch]})")
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR)}")
    return importlib.import_module(_MODULE_FOR[arch]).CONFIG


DTYPES = ("float32", "bfloat16")        # the drivers' --dtype choices


def with_dtype(cfg: ModelConfig, dtype: str) -> ModelConfig:
    """``cfg`` with ``param_dtype`` and ``compute_dtype`` both ``dtype``:
    the drivers' ``--dtype`` (at bfloat16, the JAX dry-run's
    ``production_dtypes``), the route to the fields the JAX drivers leave
    at their float32 default."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r} not in {DTYPES}")
    return replace(cfg, param_dtype=dtype, compute_dtype=dtype)


def torch_dtype(name: str):
    """``"float32"`` -> ``torch.float32`` (configs name dtypes as strings)."""
    import torch
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# input shapes (the JAX package's shape table)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Which (arch x shape) pairs run (the JAX package's skip table)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic attention (DESIGN.md)")
    return True, ""
