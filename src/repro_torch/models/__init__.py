"""PyTorch port of ``repro.models`` for the attention family (dense and
mixture-of-experts), the Mamba2 hybrid and xLSTM: layers, attention
(reference, blocked and flash), the experts, the SSM and xLSTM blocks, the
model's forwards and decode, and the converter from the JAX package's
parameter tree.  Import the modules directly (``repro_torch.models.model``
and so on)."""
