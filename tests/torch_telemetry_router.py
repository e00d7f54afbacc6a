"""Router process of the port for the fleet-telemetry drill (the port's
counterpart of tests/fixtures/telemetry_router.py).

Builds a Router over the replicas named in ROUTER_REPLICAS (JSON
``[["name", "endpoint"], ...]``) and serves until killed. The spawn env
carries PADDLE_TPU_TELEMETRY_COLLECTOR, so the process's telemetry
agent arms when the port's observability package is imported and
streams the router's spans of every forwarded generate to the
collector.

Prints one READY JSON line ({"endpoint", "pid"}).
"""
import json
import os
import time

from paddle_tpu_torch.serving.router import ReplicaSpec, Router


def main():
    replicas = [ReplicaSpec(name, ep) for name, ep in
                json.loads(os.environ["ROUTER_REPLICAS"])]
    router = Router(os.environ.get("ROUTER_ENDPOINT", "127.0.0.1:0"),
                    replicas=replicas, ping_interval=0.1,
                    ping_timeout=2.0)
    router.start()
    print(json.dumps({"endpoint": router.endpoint,
                      "pid": os.getpid()}), flush=True)
    while True:
        time.sleep(0.1)


if __name__ == "__main__":
    main()
