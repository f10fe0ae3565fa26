"""Import boundary of the PyTorch port: every toad_tpu_torch module imports
without the JAX stack (jax, pandas, h5py, ml_dtypes, orbax, optax, PIL and
matplotlib are absent on the GPU machine) and without building a kernel."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pandas", "h5py", "ml_dtypes", "orbax", "optax", "PIL", "matplotlib")

_PROBE = f"""
import importlib, json, pkgutil, sys
import toad_tpu_torch
names = [m.name for m in pkgutil.walk_packages(toad_tpu_torch.__path__, "toad_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from toad_tpu_torch.ops import _build
print(json.dumps({{
    "modules": names,
    "forbidden": [m for m in {FORBIDDEN!r} if m in sys.modules],
    "toad_tpu": sorted(m for m in sys.modules if m == "toad_tpu" or m.startswith("toad_tpu.")),
    "built": _build.is_loaded(),
}}))
"""


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300, check=True
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_the_jax_stack(probe):
    assert len(probe["modules"]) >= 20
    assert probe["forbidden"] == []


def test_no_module_of_the_jax_package_is_imported(probe):
    assert probe["toad_tpu"] == []


def test_config_and_registry_match_the_jax_package():
    """The port's stdlib copies of toad_tpu.config / toad_tpu.registry keep
    the same fields, defaults and tasks (use_pallas has no counterpart)."""
    import dataclasses

    from toad_tpu import config as jax_config
    from toad_tpu import registry as jax_registry
    from toad_tpu_torch import config, registry

    assert config.DEFAULT_BUCKETS == jax_config.DEFAULT_BUCKETS
    # the fields with nothing behind them in the port yet, by name
    not_ported = {
        "ModelConfig": {"use_pallas"},
        "TaskConfig": set(),
        "OptimConfig": set(),
        "DataConfig": set(),
        "TrainConfig": set(),
        "SplitConfig": set(),
        "EncoderConfig": set(),
    }
    for name, skip in not_ported.items():
        port_cls, jax_cls = getattr(config, name), getattr(jax_config, name)
        assert skip <= {f.name for f in dataclasses.fields(jax_cls)}
        want = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_cls) if f.name not in skip]
        assert [(f.name, f.type, f.default) for f in dataclasses.fields(port_cls)] == want  # same order too
    # nested defaults and the settings echo
    port_train, jax_train = config.TrainConfig(), jax_config.TrainConfig()
    assert dataclasses.asdict(port_train.optim) == dataclasses.asdict(jax_train.optim)
    assert set(jax_train.settings_dict()) - set(port_train.settings_dict()) == not_ported["TrainConfig"]
    assert port_train.settings_dict()["num_splits"] == jax_train.settings_dict()["num_splits"]
    for args in ((10, -1, -1), (10, 2, 5), (3, -1, 2)):
        assert config.fold_range(*args) == jax_config.fold_range(*args)
    port_enc, ref_enc = config.EncoderConfig(), jax_config.EncoderConfig()
    assert (port_enc.stage_widths, port_enc.out_dim) == (ref_enc.stage_widths, ref_enc.out_dim) == ((64, 128, 256), 1024)
    import numpy as np

    from toad_tpu.models import resnet_encoder as jax_resnet

    assert np.array_equal(np.float32(config.IMAGENET_MEAN), jax_resnet.IMAGENET_MEAN)
    assert np.array_equal(np.float32(config.IMAGENET_STD), jax_resnet.IMAGENET_STD)
    for size in ("small", "big"):
        port, ref = config.ModelConfig(size_arg=size), jax_config.ModelConfig(size_arg=size)
        assert (port.hidden_dim, port.attn_dim) == (ref.hidden_dim, ref.attn_dim)
    shipped = sorted(p.name for p in (REPO / "toad_tpu" / "tasks").glob("*.json"))
    assert shipped == sorted(p.name for p in (REPO / "toad_tpu_torch" / "tasks").glob("*.json"))
    for name in shipped:
        port, ref = registry.load_task(name), jax_registry.load_task(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_classes == ref.n_classes
        assert config.TaskConfig.from_json(port.to_json()) == port
    with pytest.raises(KeyError, match="unknown task"):
        registry.load_task("no_such_task")


INT8_MODULES = (
    "toad_tpu_torch.ops.quantize",
    "toad_tpu_torch.ops.cuda_pool_int8",
    "toad_tpu_torch.pipeline.featurize",
    "toad_tpu_torch.cli.convert",
)
VIT_MODULES = (
    "toad_tpu_torch.ops.vit_attention",
    "toad_tpu_torch.ops.cuda_mha",
    "toad_tpu_torch.models.vit_encoder",
    "toad_tpu_torch.cli.featurize",
)


TRAIN_MODULES = (
    "toad_tpu_torch.config",
    "toad_tpu_torch.utils",
    "toad_tpu_torch.utils.rng",
    "toad_tpu_torch.utils.io",
    "toad_tpu_torch.utils.logging",
    "toad_tpu_torch.utils.profiling",
    "toad_tpu_torch.utils.debug",
    "toad_tpu_torch.data.bags",
    "toad_tpu_torch.data.wsi_dataset",
    "toad_tpu_torch.data.splits",
    "toad_tpu_torch.data.synthetic",
    "toad_tpu_torch.data.batching",
    "toad_tpu_torch.evaluate.metrics",
    "toad_tpu_torch.evaluate.runner",
    "toad_tpu_torch.train.optim",
    "toad_tpu_torch.train.checkpoint",
    "toad_tpu_torch.train.loop",
    "toad_tpu_torch.cli.common",
    "toad_tpu_torch.cli.train",
    "toad_tpu_torch.cli.create_splits",
    "toad_tpu_torch.cli.make_dummy",
    "toad_tpu_torch.parallel",
    "toad_tpu_torch.parallel.bag_shard",
    "toad_tpu_torch.models.interop",
)


RESNET_MODULES = (
    "toad_tpu_torch.models.resnet_encoder",
    "toad_tpu_torch.ops.fused_stage",
    "toad_tpu_torch.pipeline.tiling",
    "toad_tpu_torch.cli.tile",
)


EVAL_MODULES = (
    "toad_tpu_torch.evaluate",
    "toad_tpu_torch.evaluate.calibration",
    "toad_tpu_torch.evaluate.engine",
    "toad_tpu_torch.cli.evaluate",
    "toad_tpu_torch.cli.report",
    "toad_tpu_torch.cli.validate",
    "toad_tpu_torch.__main__",
)


INFER_MODULES = (
    "toad_tpu_torch.pipeline.infer",
    "toad_tpu_torch.pipeline.heatmap",
    "toad_tpu_torch.cli.infer",
    "toad_tpu_torch.cli.predict",
    "toad_tpu_torch.cli.heatmap",
    "toad_tpu_torch.cli.export",
)


PROBE_MODULES = (
    "toad_tpu_torch.ops.probe_pool",
    "toad_tpu_torch.ops.probe_pool_int8",
    "toad_tpu_torch.experiments",
    "toad_tpu_torch.experiments.mfu_probe",
    "toad_tpu_torch.experiments.int8_probe",
    "toad_tpu_torch.experiments.longbag_probe",
    "toad_tpu_torch.experiments.vit_probe_common",
    "toad_tpu_torch.experiments.vit_softmax_probe",
    "toad_tpu_torch.experiments.vit_attn_probe",
    "toad_tpu_torch.experiments.vit_ceiling2_probe",
    "toad_tpu_torch.experiments.vit_elementwise_probe",
    "toad_tpu_torch.experiments.vit_profile",
    "toad_tpu_torch.experiments.vit_int8_probe",
    "toad_tpu_torch.experiments.io_overlap_probe",
    "toad_tpu_torch.experiments.bf16_transfer_probe",
    "toad_tpu_torch.experiments.patient_native_probe",
    "toad_tpu_torch.experiments.matmul_ceiling",
    "toad_tpu_torch.experiments.encoder_batch_ab",
    "toad_tpu_torch.experiments.encoder_stages",
)


SERVE_MODULES = (
    "toad_tpu_torch.serve",
    "toad_tpu_torch.serve.batcher",
    "toad_tpu_torch.serve.server",
    "toad_tpu_torch.cli.serve",
    "toad_tpu_torch.experiments.serve_load",
)


@pytest.mark.parametrize("module", INT8_MODULES + VIT_MODULES + TRAIN_MODULES + EVAL_MODULES + RESNET_MODULES
                         + PROBE_MODULES + INFER_MODULES + SERVE_MODULES)
def test_int8_modules_import_neither_jax_nor_the_jax_package(probe, module):
    """Each module of the int8, ViT and ResNet featurization, training, evaluation, slide-inference and serving paths, imported alone
    in a fresh process, loads no module of the JAX stack (h5py and PIL
    included), of toad_tpu, of the repo's ``bench.py`` or of its JAX probes
    (``experiments/``) and builds no kernel."""
    assert module in probe["modules"]
    code = (
        f"import importlib, json, sys; importlib.import_module({module!r}); "
        "from toad_tpu_torch.ops import _build; "
        f"print(json.dumps([m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('toad_tpu', 'bench', 'experiments')!r}] "
        "+ (['built'] if _build.is_loaded() else [])))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_import_builds_no_kernel(probe):
    assert probe["built"] is False


def test_dispatcher_lists_only_ported_commands():
    out = subprocess.run(
        [sys.executable, "-m", "toad_tpu_torch", "--help"], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0
    listed = [line.split()[0] for line in out.stdout.splitlines() if line.startswith("  ")]
    from toad_tpu.__main__ import COMMANDS as JAX_COMMANDS

    assert set(listed) == set(JAX_COMMANDS) and len(listed) == len(JAX_COMMANDS) == 14  # every command is ported
    bad = subprocess.run(
        [sys.executable, "-m", "toad_tpu_torch", "no-such-command"], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert bad.returncode == 2 and "unknown command" in bad.stderr


def test_kernel_sources_are_packaged():
    import tomllib

    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert "toad_tpu_torch*" in cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    data = cfg["tool"]["setuptools"]["package-data"]["toad_tpu_torch"]
    assert "csrc/*.cu" in data and "tasks/*.json" in data
    assert {p.name for p in (REPO / "toad_tpu_torch" / "csrc").glob("*.cu")} >= {"pool.cu", "pool_int8.cu", "mha.cu", "stage.cu"}


def test_no_source_line_imports_jax_or_the_jax_package():
    """The grep of the port's sources and of chip_smoke.py: no import
    statement names jax, toad_tpu, bench.py or the JAX probes' experiments/,
    also not inside a function."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|toad_tpu|bench|experiments)(\.|\s|$)")
    files = [*(REPO / "toad_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(files) > 40
    hits = [f"{f.relative_to(REPO)}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert hits == []
