"""Finding a cell's data by name: BENCHMARK.json's entry, the
configuration file, the mix, the limits, the kernel's work table, the
peaks of the card, and the readers of the per-layer metrics."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the env-side and the training-side groups of a configuration file
ENV_GROUPS = ("env", "terrain", "commands", "init_state", "control",
              "asset", "domain_rand", "rewards", "normalization", "noise",
              "viewer", "sim")
TRAIN_GROUPS = ("seed", "policy", "algorithm", "runner")


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def benchmark_file():
    return load_json(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict       # configs/<config>.json
    mix: dict          # mixes/<traffic>.json
    limits: dict       # limits/<cell>.json ({} where none is set)
    end_to_end: list   # BENCHMARK.json's end_to_end entries of this cell
    per_layer: list    # BENCHMARK.json's per_layer entries of this cell

    @property
    def kind(self):
        return self.mix["kind"]

    @property
    def num_envs(self):
        return int(self.mix.get("num_envs") or self.config["env"]["num_envs"])

    def work(self):
        """The frozen work of the kernel this cell launches."""
        name = self.mix.get("kernel_work") or self.config["kernel_work"]
        return load_json(HERE, "work", name + ".json")


def _in_cell(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, bench=None):
    bench = benchmark_file() if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    limits_path = os.path.join(HERE, "limits", name + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(
        name=name, config_name=entry["config"], traffic=entry["traffic"],
        chips=int(entry["chips"]), config=load_json(ROOT, config["file"]),
        mix=load_json(HERE, "mixes", entry["traffic"] + ".json"),
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)])


def peaks():
    return load_json(HERE, "peaks.json")


def _fill(obj, values, path):
    """Set every field of the dataclass ``obj`` named in ``values``; a
    nested dataclass is filled field by field, anything else replaced
    whole. A key the dataclass lacks raises."""
    for key, value in values.items():
        if not hasattr(obj, key):
            raise KeyError(f"configuration key {path}{key} is not a field "
                           f"of {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _fill(current, value, f"{path}{key}.")
        else:
            setattr(obj, key, value)


def build_cfgs(config_module, config, num_envs):
    """(env cfg, train cfg) of a configuration file, built on the
    defaults of ``config_module`` (the port's config module or the
    reference's copy) with every group of the file set over them."""
    env_cfg = config_module.LeggedRobotCfg()
    train_cfg = config_module.TrainCfg()
    _fill(env_cfg, {k: config[k] for k in ENV_GROUPS if k in config}, "")
    _fill(train_cfg, {k: config[k] for k in TRAIN_GROUPS if k in config}, "")
    env_cfg.env.num_envs = int(num_envs)
    return env_cfg, train_cfg


def metric_reader(name):
    """The reader of a per-layer metric: metrics/<name>.py, else the file
    of the name before its first dot (a metric split by the end-to-end
    metric it moves shares its reader)."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "benchmark_metric_" + stem.replace(".", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for the per-layer metric {name!r}")
