"""File and config IO (counterpart of ``tensorflowasr_tpu/utils/file_util.py``).

``load_yaml`` renders a Jinja2-templated YAML config with ``repodir``,
``curdir``, ``datadir`` and ``modeldir`` and parses it with PyYAML, with
scientific notation without a decimal point (``1e-9``) read as a float.
Jinja2 and PyYAML are imported inside it, so that the modules that only
read manifests, audio or vocabularies import without them.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from typing import Any, Iterator, Union

PathLike = Union[str, os.PathLike]

# the repository root: this file is tensorflowasr_tpu_torch/utils/file_util.py
REPODIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# PyYAML reads 1e-6 (no decimal point) as a string; this resolver reads it as a float
_FLOAT_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)


def preprocess_paths(path: PathLike | None, isdir: bool = False) -> str | None:
    """Expand ~ and environment variables; create the parent directories
    (the directory itself with ``isdir``) so that writes succeed."""
    if path is None:
        return None
    path = os.path.abspath(os.path.expanduser(os.path.expandvars(str(path))))
    dirpath = path if isdir else os.path.dirname(path)
    if dirpath and not os.path.exists(dirpath):
        os.makedirs(dirpath, exist_ok=True)
    return path


def load_yaml(path: PathLike, custom_vars: dict | None = None, **kwargs) -> dict:
    """Load a YAML (optionally Jinja2 ``.j2``) config file.

    Template variables: ``repodir`` (the repository root, or
    ``TFASR_REPODIR``), ``curdir`` (the file's directory), ``datadir`` and
    ``modeldir`` (``TFASR_DATADIR`` / ``TFASR_MODELDIR``, else ``data`` and
    ``models`` under the repository), each overridden by ``custom_vars``
    and keyword arguments. ``{% include %}`` and ``{% import %}`` resolve
    against the file's directory and the repository root."""
    import jinja2
    import yaml

    path = os.path.abspath(os.path.expanduser(os.path.expandvars(str(path))))
    repodir = os.environ.get("TFASR_REPODIR", REPODIR)
    template_vars: dict[str, Any] = {
        "repodir": repodir,
        "curdir": os.path.dirname(path),
        "datadir": os.environ.get("TFASR_DATADIR", os.path.join(repodir, "data")),
        "modeldir": os.environ.get("TFASR_MODELDIR", os.path.join(repodir, "models")),
    }
    template_vars.update(custom_vars or {})
    template_vars.update(kwargs)
    with open(path, "r", encoding="utf-8") as f:
        raw = f.read()
    env = jinja2.Environment(undefined=jinja2.ChainableUndefined,
                             loader=jinja2.FileSystemLoader([os.path.dirname(path), str(template_vars["repodir"]), repodir, "/"]))
    rendered = env.from_string(raw).render(**template_vars)

    class Loader(yaml.SafeLoader):
        pass

    Loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT_RE, list("-+0123456789."))
    return yaml.load(rendered, Loader=Loader) or {}


def save_json(path: PathLike, obj: Any) -> None:
    with open(preprocess_paths(path), "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True, default=str)


def load_json(path: PathLike) -> Any:
    with open(os.path.abspath(os.path.expanduser(str(path))), "r", encoding="utf-8") as f:
        return json.load(f)


@contextlib.contextmanager
def atomic_write(path: PathLike, mode: str = "w") -> Iterator[Any]:
    """Write to a temporary file in the target's directory, then rename it into place."""
    p = preprocess_paths(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p))
    try:
        with os.fdopen(fd, mode) as f:
            yield f
        os.replace(tmp, p)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
