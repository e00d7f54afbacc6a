"""paddle_tpu_torch.distributed — only ``fleet.runtime.fault_injection``
so far (the fault injector the checkpoint writer and the serving engine
call); the collectives, the mesh and the fleet facade of
``paddle_tpu.distributed`` are not ported yet (ROADMAP.md A)."""
