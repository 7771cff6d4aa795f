"""Core runtime of the port: Step, DistAlgorithm, FaultLog, NetworkInfo
and canonical serialization."""
