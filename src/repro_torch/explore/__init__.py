"""repro_torch.explore — declarative, serializable, resumable DSE campaigns
on the PyTorch port (the port's copy of `repro.explore`):

    from repro_torch.explore import Campaign, CampaignSpec
    spec = CampaignSpec.from_json("examples/campaigns/quick_train_mfmobo.json")
    result = Campaign(spec).run(checkpoint_path="run.ckpt")      # on the card
    result = Campaign.resume("run.ckpt", device="cpu").run()     # continue

CLI: ``python -m repro_torch.explore <spec>.json [--resume CKPT]
[--device cpu]``. Campaign fleets (`repro.explore.fleet`) wait for ROADMAP
item 8.
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
    unported,
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
from repro_torch.explore.runner import (  # noqa: F401
    ExplorationLoop,
    LoopConfig,
    LoopState,
    PendingBatch,
    STRATEGIES,
)
