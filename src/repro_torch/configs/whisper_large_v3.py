"""whisper-large-v3 [audio] -- enc-dec, 32+32L d1280 20H (MHA) dff5120
vocab51866; the conv/mel frontend is a stub. [arXiv:2212.04356]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="whisper", n_layers=32, n_enc_layers=32,
    d_model=1280, vocab_size=51866, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, norm="layer", n_audio_ctx=1500)

REDUCED = CONFIG.replace(
    name="whisper-large-v3-reduced", n_layers=2, n_enc_layers=2, d_model=64,
    vocab_size=499, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=256,
    n_audio_ctx=32, dtype="float32")
