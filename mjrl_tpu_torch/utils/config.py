"""Experiment configuration loading (counterpart of
``mjrl_tpu/utils/config.py``).

One loader for the three formats of the repo's job scripts, none of which
executes the file:

- .json            -> json.load
- .yaml / .yml     -> yaml.safe_load (when ``yaml`` is importable)
- .txt / .config   -> ast.literal_eval of a Python dict literal

plus dotted-key overrides (``train.niter=5``).  ``save_config`` echoes the
config to the job directory as ``job_config.json``.
"""

import ast
import json
import os


def load_config(path):
    ext = os.path.splitext(path)[1].lower()
    with open(path) as f:
        text = f.read()
    if ext == ".json":
        return json.loads(text)
    if ext in (".yaml", ".yml"):
        import yaml
        return yaml.safe_load(text)
    return ast.literal_eval(text)


def apply_overrides(config, overrides):
    """overrides: list of 'dotted.key=value' strings; values parsed as
    Python literals when possible."""
    for item in overrides or []:
        key, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return config


def save_config(config, job_dir, name="job_config.json"):
    os.makedirs(job_dir, exist_ok=True)
    path = os.path.join(job_dir, name)

    def default(o):
        if isinstance(o, tuple):
            return list(o)
        return str(o)

    with open(path, "w") as f:
        json.dump(config, f, indent=4, default=default)
    return path
