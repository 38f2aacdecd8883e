"""ThunderServe core: two-level scheduling of phase-split LLM serving over
heterogeneous device pools (the paper's contribution).

Pipeline: ClusterSpec -> tabu search (group construction + phase designation)
x { parallel-config deduction + TSTP orchestration } -> DeploymentPlan ->
event simulator (SLO attainment) / serving runtime.

The port's copy of ``repro.core`` (numpy/scipy only, no torch);
``tests/test_torch_isolation.py`` holds its code to the reference's,
definition by definition.
"""
from repro_torch.core.cluster import ClusterSpec, DeviceSpec, make_paper_cloud  # noqa: F401
from repro_torch.core.scheduler import DeploymentPlan, schedule  # noqa: F401
