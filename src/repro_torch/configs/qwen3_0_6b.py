"""qwen3-0.6b — dense GQA with per-head q/k RMSNorm.
[hf:Qwen/Qwen3-8B] (assigned spec: 28L d_model=1024 16H GQA kv=8,
d_ff=3072, vocab=151936, qk_norm)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,           # qwen3 uses fixed head_dim=128 (> d_model/H)
    rope_theta=1_000_000.0,
    sliding_window=8192,
    citation="hf:Qwen/Qwen3-8B",
)
