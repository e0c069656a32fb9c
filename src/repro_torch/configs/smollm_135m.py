"""smollm-135m [dense]: llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]
Mirrors ``repro/configs/smollm_135m.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="smollm-135m-reduced", n_layers=2, d_model=48, n_heads=3,
        n_kv_heads=1, head_dim=16, d_ff=96, vocab_size=256,
    )
