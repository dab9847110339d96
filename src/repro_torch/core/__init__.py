"""Scheduler core: partitioners, queues and the host executors, the
pipeline-DAG runtime, super-tables, chunk-boundary checkpoints with
host<->device migration, the lowering toolkit, the config registry and
the front door's same-shape batching."""

from .admission import (
    BatchPolicy,
    batch_signature,
    coalesce_submissions,
    merge_dags,
)
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
    build_dag_tables,
    build_dag_tables_cached,
    build_task_table,
    clear_dag_table_cache,
    dag_signature,
    dag_table_cache_stats,
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
    OnlineScheduler,
    StageFeedback,
    UCB1Selector,
    default_online_arms,
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
    "DEP_FULL", "DEP_ELEMENTWISE", "Stage", "StageDep", "PipelineDAG",
    "PipelineExecutor", "StageResult", "DagResult", "TaskEvent",
    "EventLog", "NullEventLog",
    "DeviceDagTables", "build_dag_tables", "build_task_table",
    "dag_signature", "build_dag_tables_cached", "dag_table_cache_stats",
    "clear_dag_table_cache",
    "ChunkObservation", "StageFeedback", "FeedbackLog", "OnlineChoice",
    "OnlineScheduler", "UCB1Selector", "EXP3Selector", "SELECTORS",
    "default_online_arms",
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
