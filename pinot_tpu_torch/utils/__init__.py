"""Process-wide observability the cluster roles record into: the metrics
registry (`metrics`), request traces (`trace`) and the event journal
(`events`)."""
