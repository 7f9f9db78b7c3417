"""Dynamics: time-varying D2D environments and online orchestration
(mirrors ``repro.dynamics``). ``scenarios.py`` holds the preset registry,
``environment.py`` the channel/availability process, ``orchestrator.py``
the simulation loop, ``metrics.py`` the per-segment trace and ``draws.py``
the orchestrator's draw source."""
from repro_torch.dynamics.draws import SeededDraws  # noqa: F401
from repro_torch.dynamics.environment import (EnvDraws,  # noqa: F401
                                              EnvState, env_init, env_step,
                                              stragglers_from)
from repro_torch.dynamics.metrics import (PendingSegment,  # noqa: F401
                                          SegmentRecord, Trace)
from repro_torch.dynamics.orchestrator import (  # noqa: F401
    CHECKPOINT_NAME, MODES, OrchestratorConfig, OrchestratorResult,
    run_orchestrator)
from repro_torch.dynamics.runstate import (RunState,  # noqa: F401
                                           load_run_state, save_run_state)
from repro_torch.dynamics.scenarios import (ScenarioConfig,  # noqa: F401
                                            available_scenarios,
                                            get_scenario, register_scenario)
