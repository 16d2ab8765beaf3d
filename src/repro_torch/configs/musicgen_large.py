"""MusicGen-large — decoder-only transformer backbone over EnCodec tokens.
The EnCodec frontend is a STUB: input_specs provide precomputed frame
embeddings; the backbone predicts codebook tokens (vocab 2048).
[arXiv:2306.05284; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    embed_inputs=False,   # modality frontend stubbed (frame embeddings in)
)
