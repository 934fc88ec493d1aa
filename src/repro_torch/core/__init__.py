"""PyTorch port of ``repro.core``: the persistent fleet state, the two-stage
scheduling decision, the incremental ``SoAFleet`` mirror and the
``SoASimulator`` event loop.  Import the modules directly
(``repro_torch.core.soa_fleet`` and so on); this package imports nothing
eagerly, so ``repro_torch.kernels`` can import the shared screen math without
a cycle.  The sharding helpers of the JAX package's ``repro.core`` are
exported here too, loaded at first use.
"""

_SHARDING = ("fleet_mesh", "merge_shortlists", "pad_fleet_state", "padded_hosts",
             "padded_hosts_for", "shard_fleet_state")

__all__ = list(_SHARDING)


def __getattr__(name):
    if name in _SHARDING:
        from . import fleet_sharding

        return getattr(fleet_sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
