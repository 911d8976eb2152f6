"""Mean share of the engine's lanes busy in a step (EngineSnapshot.slot_utilization)."""


def read(record):
    snap = record.host.get("snapshot")
    return 100.0 * snap["slot_utilization"] if snap and snap["steps"] else None
