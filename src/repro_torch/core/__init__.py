"""The port of ``repro.core``: sampling, aggregation, the stale store,
the method strategies and the round engine."""
