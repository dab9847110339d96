"""Scheduler core: partitioners, the pipeline-DAG data model, super-tables."""

from .dag import DEP_ELEMENTWISE, DEP_FULL, PipelineDAG, Stage, StageDep
from .device_schedule import (
    DeviceDagTables,
    build_dag_tables,
    build_dag_tables_cached,
    build_task_table,
    clear_dag_table_cache,
    dag_signature,
    dag_table_cache_stats,
)
from .partitioners import PARTITIONERS, chunk_schedule, make_partitioner

__all__ = [
    "DEP_ELEMENTWISE", "DEP_FULL", "PipelineDAG", "Stage", "StageDep",
    "DeviceDagTables", "build_dag_tables", "build_dag_tables_cached",
    "build_task_table", "clear_dag_table_cache", "dag_signature",
    "dag_table_cache_stats", "PARTITIONERS", "chunk_schedule",
    "make_partitioner",
]
