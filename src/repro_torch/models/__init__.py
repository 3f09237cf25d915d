"""Model code of the port: shared blocks, attention, the decoders of every
family, the Whisper encoder, the loss and the bundle.

The public API of ``models.model`` is exported as the reference's package
exports it, but loaded on first use: the kernel wrappers import
``models.attention`` and ``models.linear_attn`` (their plain versions), and
``models.model`` imports the decoder, which imports the kernel wrappers.
"""
__all__ = ["ModelBundle", "build", "cross_entropy", "example_batch",
           "lm_loss"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.models import model
        return getattr(model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
