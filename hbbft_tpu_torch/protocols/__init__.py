"""The protocol state machines of ``hbbft_tpu/protocols``: Broadcast,
Agreement, CommonCoin, CommonSubset, HoneyBadger, SyncKeyGen,
DynamicHoneyBadger, QueueingHoneyBadger, and their data types."""
