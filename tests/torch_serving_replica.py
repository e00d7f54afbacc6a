"""Killable serving replica of the port, the launcher's
``--serving_replicas`` child (the port's counterpart of
tests/fixtures/serving_replica.py).

Builds an Engine on the CPU from a checkpoint manifest
(``Engine.from_checkpoint``, the respawn path) and serves it with
``ServingServer`` on ``PADDLE_TPU_REPLICA_ENDPOINT``.

Env:
  PADDLE_TPU_REPLICA_ENDPOINT  where to listen (required)
  REPLICA_CKPT                 checkpoint root (required)
  REPLICA_ENGINE_KW            JSON dict of Engine kwargs (optional)
  REPLICA_ARM_FAULT_FILE       optional path: the PADDLE_PS_FAULT_* knobs
      of the spawn env are stashed at startup and restored (the injector
      re-armed from them) once this file appears — e.g. KILL_AFTER=1
      dies on the next request. Without it the knobs are restored once
      the engine is built, before the server listens, so they hold from
      the first request.
  REPLICA_KEEP_FAULTS          optional comma list of PADDLE_PS_FAULT_*
      names exempt from the stash: live from the start (e.g. a decode
      STALL that keeps a stream in flight while KILL waits for the arm
      file).

Prints one READY JSON line ({"endpoint", "pid"}), then serves until
killed.
"""
import json
import os
import time

# stash the fault knobs BEFORE any import of the port can arm the injector
_KEEP = {k for k in
         (os.environ.get("REPLICA_KEEP_FAULTS") or "").split(",") if k}
_STASHED = {k: os.environ.pop(k) for k in list(os.environ)
            if k.startswith("PADDLE_PS_FAULT_") and k not in _KEEP}

import torch  # noqa: E402

from paddle_tpu_torch.distributed.fleet.runtime import (  # noqa: E402
    fault_injection as fi)
from paddle_tpu_torch.serving import Engine, ServingServer  # noqa: E402


def main():
    torch.set_num_threads(1)
    engine_kw = json.loads(os.environ.get("REPLICA_ENGINE_KW") or "{}")
    engine = Engine.from_checkpoint(os.environ["REPLICA_CKPT"],
                                    device="cpu", **engine_kw)
    arm_file = os.environ.get("REPLICA_ARM_FAULT_FILE")
    armed = False
    if arm_file is None and _STASHED:
        # before the socket listens: a request that raced a later
        # restore could run its whole decode without the knobs
        os.environ.update(_STASHED)
        fi.reset_injector(None)
        armed = True
    server = ServingServer(engine,
                           os.environ["PADDLE_TPU_REPLICA_ENDPOINT"])
    server.start()
    print(json.dumps({"endpoint": server.endpoint, "pid": os.getpid()}),
          flush=True)
    while True:
        if arm_file and not armed and os.path.exists(arm_file):
            os.environ.update(_STASHED)
            fi.reset_injector(None)      # re-read env: knobs now live
            armed = True
            print(json.dumps({"armed": sorted(_STASHED)}), flush=True)
        time.sleep(0.05)


if __name__ == "__main__":
    main()
