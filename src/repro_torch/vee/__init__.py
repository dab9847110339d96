"""Vectorized execution engine: data + operators -> tasks -> DaphneSched.

The paper's IDA pipelines on the host pool (the VEE and the pipeline-DAG
runtime) and on the device walker, and the MoE expert dispatch."""

from .apps import (
    DeviceLowering,
    cc_iteration_dag,
    cc_step_numpy,
    connected_components,
    connected_components_dag,
    hetero_affinity_dag,
    linear_regression,
    linear_regression_dag,
    linear_regression_device,
    linear_regression_hetero,
    linear_regression_online,
    linreg_dag,
    linreg_device_lowering,
    recommendation_dag,
    recommendation_device,
    recommendation_device_lowering,
    recommendation_hetero,
    recommendation_online,
    recommendation_oracle,
    recommendation_pipeline,
    run_device_dag,
)
from .engine import VEE, PipelineResult
from .ml_apps import (
    moe_device_lowering,
    moe_dispatch_lowering,
    serving_pair,
    skewed_tokens,
    transformer_step_lowering,
)
from .sparse import CSRMatrix, replicated_graph, rmat_graph

__all__ = [
    "VEE", "PipelineResult", "CSRMatrix", "rmat_graph", "replicated_graph",
    "connected_components", "linear_regression", "cc_step_numpy",
    "cc_iteration_dag", "connected_components_dag", "linreg_dag",
    "linear_regression_dag", "recommendation_dag",
    "recommendation_pipeline", "recommendation_oracle",
    "linear_regression_online", "recommendation_online",
    "DeviceLowering", "run_device_dag", "linreg_device_lowering",
    "linear_regression_device", "recommendation_device_lowering",
    "recommendation_device", "linear_regression_hetero",
    "recommendation_hetero", "hetero_affinity_dag",
    "transformer_step_lowering", "moe_dispatch_lowering",
    "moe_device_lowering", "skewed_tokens", "serving_pair",
]
