"""The PyTorch port stands alone: no file of paddle_tpu_torch/, and not
chip_smoke.py, imports jax or paddle_tpu, and the package imports on a
host with neither nvcc nor triton (kernels build at first use)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            mods.append(str(node.args[0].value))
    return mods


def test_port_file_list_is_not_empty():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "model.py", "gpt.py", "paged_attention.py",
            "fused_block.py", "flash_attention.py", "hybrid.py",
            "optimizer_ops.py", "chip_smoke.py", "layer_norm.py",
            "fused_residual.py", "_launch.py", "auto_cast.py",
            "functional.py", "layers_common.py", "initializer.py",
            "transformer.py", "bert.py", "perf.py", "fused_ffn.py",
            "common_ops.py", "unique_name.py", "core.py", "framework.py",
            "registry.py", "scope.py", "param_attr.py", "layer_helper.py",
            "backward.py", "optimizer.py", "executor.py", "math_ops.py",
            "nn_ops.py", "tensor_ops.py", "random_ops.py", "metric_ops.py",
            "math_op_patch.py", "lenet.py", "resnet.py", "vgg.py",
            "mobilenet.py", "models.py", "wide_deep.py", "store.py",
            "chunks.py", "manifest.py", "wal.py",
            "fault_injection.py", "watchdog.py", "debug.py", "loadgen.py",
            "frontend.py", "rpc.py", "parameter_server_runtime.py",
            "ps_ha.py", "tiered_store.py", "launch.py", "elastic.py",
            "cluster_ckpt.py", "exporter.py", "subscriber.py",
            "agent.py", "alerts.py", "collector.py",
            "timeseries.py", "router.py", "top.py", "perfwatch.py",
            "selected_rows.py", "sequence_ops.py", "structured_loss_ops.py",
            "misc_ops.py", "tail_ops.py"} <= names
    assert ROOT / "paddle_tpu_torch" / "publish" / "registry.py" \
        in PORT_FILES
    assert ROOT / "paddle_tpu_torch" / "distributed" / "fleet" \
        / "runtime" / "rpc.py" in PORT_FILES


def _calls(path: Path, names) -> list[ast.Call]:
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", getattr(n.func, "id", ""))
            in names]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_dynamic_imports(path):
    """Every import the AST walk cannot read is refused: an
    ``__import__`` / ``import_module`` of a computed name (the JAX
    package's debug bundles record versions through
    ``__import__(mod)`` over ("jax", "jaxlib", "numpy"))."""
    bad = [ast.unparse(c) for c in _calls(path, ("import_module",
                                                 "__import__"))
           if not (c.args and isinstance(c.args[0], ast.Constant))]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_debug_bundles_name_no_jax():
    """The port's bundle env section records torch, its CUDA, numpy and
    the card, never jax: no string in debug.py names it."""
    path = ROOT / "paddle_tpu_torch" / "observability" / "debug.py"
    text = path.read_text()
    assert '__import__("jax")' not in text \
        and "__import__('jax')" not in text
    tree = ast.parse(text, filename=str(path))
    consts = {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert not consts & {"jax", "jaxlib", "JAX_", "XLA_"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_needs_no_nvcc_triton_or_jax():
    """A fresh interpreter whose PATH has no nvcc, with triton and jax
    made unimportable, imports the whole package."""
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('triton', 'jax', 'jaxlib',"
        " 'paddle_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving,"
        " paddle_tpu_torch.observability\n"
        "import paddle_tpu_torch.ops.paged_attention,"
        " paddle_tpu_torch.ops.fused_block,"
        " paddle_tpu_torch.ops.flash_attention\n"
        "import paddle_tpu_torch.parallel,"
        " paddle_tpu_torch.fluid.ops.optimizer_ops\n"
        "import paddle_tpu_torch.ops.layer_norm,"
        " paddle_tpu_torch.ops.fused_residual\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.nn,"
        " paddle_tpu_torch.nn.transformer, paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.models.bert\n"
        "import paddle_tpu_torch.ops.fused_ffn, paddle_tpu_torch.common_ops\n"
        "import paddle_tpu_torch.static, paddle_tpu_torch.fluid.layers\n"
        "import paddle_tpu_torch.fluid.ops, paddle_tpu_torch.fluid.executor\n"
        "import paddle_tpu_torch.fluid.optimizer, paddle_tpu_torch.fluid.backward\n"
        "import paddle_tpu_torch.models.lenet, paddle_tpu_torch.vision\n"
        "import paddle_tpu_torch.checkpoint,"
        " paddle_tpu_torch.models.wide_deep\n"
        "import paddle_tpu_torch.distributed.fleet.runtime.fault_injection\n"
        "import paddle_tpu_torch.distributed.fleet.runtime.rpc\n"
        "import paddle_tpu_torch.observability.watchdog,"
        " paddle_tpu_torch.observability.debug\n"
        "import paddle_tpu_torch.serving.loadgen,"
        " paddle_tpu_torch.serving.frontend\n"
        "import paddle_tpu_torch.publish,"
        " paddle_tpu_torch.observability.agent\n"
        "import paddle_tpu_torch.observability.collector,"
        " paddle_tpu_torch.observability.alerts,"
        " paddle_tpu_torch.observability.timeseries\n"
        "import paddle_tpu_torch.serving.router,"
        " paddle_tpu_torch.observability.top,"
        " paddle_tpu_torch.observability.perfwatch\n"
        "from paddle_tpu_torch.ops import launch_counts\n"
        "assert launch_counts() == {}\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_publish_and_telemetry_import_without_torch():
    """The publish tier and the telemetry plane (with the ``top``
    dashboard and ``perfwatch``) load on a host process that never
    imports torch (a PS shard, a collector child, an operator's
    terminal): only
    ``Publisher.publish_model`` and ``VersionSubscriber``'s engine swap
    need it, and they import it when called."""
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'jax', 'paddle_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import paddle_tpu_torch.publish\n"
        "import paddle_tpu_torch.observability.collector\n"
        "from paddle_tpu_torch.observability import agent, alerts, "
        "perfwatch, timeseries, top\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
