"""Scheduler core: partitioners, queues and the host executors, the
pipeline-DAG runtime, super-tables with persistent re-balancing, the
distributed coordinator, the discrete-event simulator and the auto-tuners,
chunk-boundary checkpoints with host<->device migration, the lowering
toolkit, the config registry and the front door's same-shape batching."""

from .admission import (
    BatchPolicy,
    batch_signature,
    coalesce_submissions,
    merge_dags,
)
from .autotune import (
    DagTuner,
    OnlineTuner,
    OnlineTuneResult,
    default_search_space,
    select_offline,
    select_offline_dag,
    select_offline_device_dag,
    select_offline_hetero,
    select_offline_server,
    tune_online_dag,
    tune_online_hetero,
)
from .coordinator import Coordinator, CoordinatorConfig, NodeSched
from .dag import (
    DEP_ELEMENTWISE,
    DEP_FULL,
    DagResult,
    EventLog,
    NullEventLog,
    PipelineDAG,
    PipelineExecutor,
    Stage,
    StageDep,
    StageResult,
    TaskEvent,
)
from .device_schedule import (
    DeviceDagTables,
    assign_chunks,
    build_dag_tables,
    build_dag_tables_cached,
    build_task_table,
    clear_dag_table_cache,
    cost_balanced_assignment,
    dag_signature,
    dag_table_cache_stats,
    per_shard_tables,
    rebalance,
    rebalance_dag,
)
from .executor import ExecutionStats, ScheduledExecutor, SchedulerConfig
from .lower import (
    Lowered,
    chain_dag,
    costs_from_sizes,
    fanout_stage,
    measure_stage_costs,
    row_stage,
    run_direct,
)
from .online import (
    SELECTORS,
    ChunkObservation,
    EXP3Selector,
    FeedbackLog,
    OnlineChoice,
    OnlineRound,
    OnlineScheduler,
    StageFeedback,
    UCB1Selector,
    default_online_arms,
    replay_online_dag,
)
from .partitioners import PARTITIONERS, chunk_schedule, make_partitioner
from .preempt import (
    JobCheckpoint,
    PreemptableStageRun,
    PreemptiveRunner,
    StageCheckpoint,
    checkpoint_from_reference,
    migrate_to_device,
    resume_on_host,
    run_device_prefix,
)
from .queues import (
    QUEUE_IMPLS,
    QUEUE_LAYOUTS,
    CentralizedQueue,
    DistributedQueues,
    SlotCentralizedQueue,
    SlotDistributedQueues,
)
from .registry import make_config
from .simulator import (
    DagSimResult,
    DagStats,
    SimOverheads,
    SimResult,
    frozen_dag_makespans,
    simulate,
    simulate_dag,
    simulate_server,
    stats_from_events,
)
from .submit import Submission, as_submission
from .task import RangeTask, tasks_from_schedule
from .telemetry import NULL_TRACER, NullTracer, Span, Tracer, as_tracer
from .victim import VICTIM_STRATEGIES, VictimSelector, make_victim_selector

__all__ = [
    "PARTITIONERS", "chunk_schedule", "make_partitioner",
    "QUEUE_LAYOUTS", "QUEUE_IMPLS", "CentralizedQueue", "DistributedQueues",
    "SlotCentralizedQueue", "SlotDistributedQueues",
    "VICTIM_STRATEGIES", "VictimSelector", "make_victim_selector",
    "RangeTask", "tasks_from_schedule",
    "SchedulerConfig", "ScheduledExecutor", "ExecutionStats",
    "SimOverheads", "SimResult", "simulate", "DagSimResult", "simulate_dag",
    "frozen_dag_makespans", "simulate_server", "DagStats",
    "stats_from_events",
    "DEP_FULL", "DEP_ELEMENTWISE", "Stage", "StageDep", "PipelineDAG",
    "PipelineExecutor", "StageResult", "DagResult", "TaskEvent",
    "EventLog", "NullEventLog",
    "Coordinator", "CoordinatorConfig", "NodeSched",
    "build_task_table", "assign_chunks", "per_shard_tables", "rebalance",
    "cost_balanced_assignment",
    "DeviceDagTables", "build_dag_tables", "rebalance_dag",
    "dag_signature", "build_dag_tables_cached", "dag_table_cache_stats",
    "clear_dag_table_cache",
    "select_offline", "OnlineTuner", "default_search_space",
    "select_offline_dag", "DagTuner", "select_offline_server",
    "select_offline_device_dag", "select_offline_hetero",
    "tune_online_hetero",
    "ChunkObservation", "StageFeedback", "FeedbackLog", "OnlineChoice",
    "OnlineRound", "OnlineScheduler", "UCB1Selector", "EXP3Selector",
    "SELECTORS", "default_online_arms",
    "replay_online_dag", "OnlineTuneResult", "tune_online_dag",
    "Submission", "as_submission",
    "Lowered", "row_stage", "chain_dag", "fanout_stage", "run_direct",
    "measure_stage_costs", "costs_from_sizes",
    "make_config",
    "batch_signature", "merge_dags", "coalesce_submissions", "BatchPolicy",
    "StageCheckpoint", "JobCheckpoint", "PreemptableStageRun",
    "PreemptiveRunner", "resume_on_host", "migrate_to_device",
    "run_device_prefix", "checkpoint_from_reference",
    "Tracer", "NullTracer", "NULL_TRACER", "as_tracer", "Span",
]
