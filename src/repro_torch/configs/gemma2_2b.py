"""gemma2-2b [dense]: local+global alternating attention, logit softcap.
[arXiv:2408.00118; hf]  Mirrors ``repro/configs/gemma2_2b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    alt_local_global=True,
    sliding_window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    tie_embeddings=True,
    # alternating layers still include full-attention (global) layers
    skip_shapes=("long_500k",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-2b-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, sliding_window=16,
    )
