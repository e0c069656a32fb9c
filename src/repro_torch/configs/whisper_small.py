"""whisper-small [audio]: encoder-decoder with the Conv1D mel stem.
[arXiv:2212.04356]  Mirrors ``repro/configs/whisper_small.py``.

The encoder's input is raw log-mel frames (batch, 2*encoder_seq, n_mels);
the model's own two-layer Conv1D stem (k 3 s 1, then k 3 s 2, GELU after
each) embeds and 2x-downsamples them to (batch, encoder_seq, d_model).
Both convs are K-FAC-tagged and preconditioned by ``ConvKronecker`` (KFC,
1602.01407).  n_layers counts decoder layers; encoder_layers the
(full-attention) encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    frontend="audio",
    frontend_tokens=1500,
    n_mels=80,
    skip_shapes=("long_500k",),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-small-reduced", n_layers=2, encoder_layers=2,
        encoder_seq=16, d_model=48, n_heads=3, n_kv_heads=3, head_dim=16,
        d_ff=96, vocab_size=256, frontend_tokens=16, n_mels=8,
    )
