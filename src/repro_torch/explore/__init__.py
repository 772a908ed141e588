"""repro_torch.explore — declarative, serializable, resumable DSE campaigns
on the PyTorch port (the port's copy of `repro.explore`):

    from repro_torch.explore import Campaign, CampaignSpec
    spec = CampaignSpec.from_json("examples/campaigns/quick_train_mfmobo.json")
    result = Campaign(spec).run(checkpoint_path="run.ckpt")      # on the card
    result = Campaign.resume("run.ckpt", device="cpu").run()     # continue

Fleets fan a grid of campaigns across worker processes sharing a
persistent eval cache, one device per worker:

    from repro_torch.explore import FleetSpec, run_fleet
    result = run_fleet(FleetSpec.from_json("grid.json"), device="cpu")

CLI: ``python -m repro_torch.explore <spec>.json [--resume CKPT]
[--device cpu]`` or ``python -m repro_torch.explore fleet grid.json
[--device cpu]``.
"""
from repro_torch.explore.campaign import (  # noqa: F401
    Campaign,
    CampaignResult,
    CampaignSpec,
    FidelitySchedule,
    HeteroSpec,
    SCENARIOS,
    ServingSpec,
    TRACE_POLICIES,
    TraceSpec,
    resolve_workload,
    run_campaign,
)
from repro_torch.explore.objectives import (  # noqa: F401
    ConstraintSpec,
    EvaluatorObjective,
    HeteroServingObjective,
    Objective,
    ObjectiveSpec,
    ServingObjective,
    TraceServingObjective,
    as_objective,
)
from repro_torch.explore.fleet import (  # noqa: F401
    FleetResult,
    FleetSpec,
    expand_grid,
    run_fleet,
)
from repro_torch.explore.runner import (  # noqa: F401
    ExplorationLoop,
    LoopConfig,
    LoopState,
    PendingBatch,
    STRATEGIES,
)
