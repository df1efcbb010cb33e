"""Cross-process telemetry sources: the sidecar files other processes write."""
