"""Planning and pipelines: the stage partitioners, the schedule tables, the
calibrated cost model and the pipeline-parallel trainer."""
