"""PyTorch port of ``repro.models`` for the dense attention family: layers,
attention (reference and flash), the model's forwards and decode, and the
converter from the JAX package's parameter tree.  Import the modules
directly (``repro_torch.models.model`` and so on)."""
