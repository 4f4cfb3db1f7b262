"""falcon-mamba-7b — attention-free Mamba-1 architecture.
[arXiv:2410.05355] (assigned spec: 64L d_model=4096, d_ff=0, vocab=65024,
ssm_state=16)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    citation="arXiv:2410.05355",
)
