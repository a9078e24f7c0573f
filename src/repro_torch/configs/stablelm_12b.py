"""stablelm-12b [dense] — parallel residual [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    norm="layernorm", parallel_residual=True,
)
