"""PyTorch port of ``repro.core``: the persistent fleet state, the two-stage
scheduling decision, the incremental ``SoAFleet`` mirror and the
``SoASimulator`` event loop.  Import the modules directly
(``repro_torch.core.soa_fleet`` and so on); this package imports nothing
eagerly, so ``repro_torch.kernels`` can import the shared screen math without
a cycle.
"""
