"""gemma3-1b [dense] — 5:1 local:global sliding window, 128k ctx
[hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    sliding_window=512, global_every=6,      # layer idx % 6 == 5 -> global
    rope_theta=1_000_000.0, tie_embeddings=True,
    sub_quadratic=True,   # sliding-window locals; 4 global layers keep full cache
)
