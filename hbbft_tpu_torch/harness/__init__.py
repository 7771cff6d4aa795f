"""Harnesses of the port: the batched share-verification flush and its workload."""
