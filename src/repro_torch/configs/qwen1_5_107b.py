"""qwen1.5-107b — the paper's modified Qwen1.5 (80 -> 78 layers, §4.1.1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-107b", family="dense",
    source="paper §4.1.1 (modified Qwen1.5-110B, 78 layers)",
    n_layers=78, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064, head_dim=128,
)
