"""Host runtime: tracing, the D2H transfer pipeline, the query batcher,
the device-memory ledger, metrics and the failure-policy registries."""
