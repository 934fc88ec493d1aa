"""``repro_torch`` — the preemptible-aware fleet scheduler in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``repro``, which stays the reference.  Entry points
take ``device=None``, which means ``"cuda"``; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.  Modules:

* ``repro_torch.core.soa_fleet.SoAFleet`` / ``core.simulator.SoASimulator``
  — the main path;
* ``repro_torch.core.torch_scheduler`` — ``SoAFleetState``, the decision
  core, ``schedule_step`` / ``schedule_many`` and the transitions; the
  rebuild-per-call path: ``SoAHostState``, ``build_soa_state``,
  ``schedule_decision`` and ``TorchPreemptibleScheduler``;
* ``repro_torch.core.scheduler`` — the paper's three python schedulers
  (``FilterScheduler``, ``RetryScheduler``, ``PreemptibleScheduler``) over
  ``core.filters``, ``core.weighers`` and ``core.select_terminate``, with
  ``core.cluster.Cluster`` and ``core.simulator.Simulator`` to drive them;
* ``repro_torch.core.admission`` — the streaming admission plane: the
  wait queue on the fleet's device, its transitions, the drain and
  ``AdmissionFrontEnd`` (``SoAFleet.submit`` / ``drain`` when the policy's
  ``queue_capacity > 0``);
* ``repro_torch.core.scan_sim`` — the trace-driven simulator: ``EventTrace``,
  ``trace_from_workload``, ``simulate_scan`` and ``simulate_ensemble`` (seed,
  weigher-multiplier and admission-knob axes), a per-event loop on the
  fleet's device, held against ``SoASimulator.run_trace``;
* ``repro_torch.core.convert`` — numpy ↔ state tensors for both state
  flavors and the wait queue (``fleet_state_*``, ``host_state_*``,
  ``queue_state_*``);
* ``repro_torch.kernels`` — the kernels, their plain versions and the launch
  counters.
"""
