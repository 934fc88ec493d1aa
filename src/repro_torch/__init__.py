"""``repro_torch`` — the preemptible-aware fleet scheduler in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``repro``, which stays the reference.  Entry points
take ``device=None``, which means ``"cuda"``; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.  Modules:

* ``repro_torch.core.soa_fleet.SoAFleet`` / ``core.simulator.SoASimulator``
  — the main path;
* ``repro_torch.core.torch_scheduler`` — ``SoAFleetState``, the decision
  core, ``schedule_step`` / ``schedule_many`` and the transitions;
* ``repro_torch.kernels`` — the kernels, their plain versions and the launch
  counters.
"""
