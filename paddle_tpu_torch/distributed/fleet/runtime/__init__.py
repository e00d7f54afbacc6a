"""paddle_tpu_torch.distributed.fleet.runtime — the fault injector
(``fault_injection``), the multiplexed RPC wire (``rpc``) the serving
frontend and the PS tier speak, the parameter-server runtime
(``parameter_server_runtime``: shards, clients, snapshots, the row-level
WAL), the HA replication plane (``ps_ha``: hot standbys, semi-sync
acks, epoch fencing, promotion) and the tiered embedding store
(``tiered_store``)."""
