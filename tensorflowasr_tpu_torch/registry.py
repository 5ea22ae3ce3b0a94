"""Config-driven class registry (counterpart of ``tensorflowasr_tpu/registry.py``).

Configs name a model as ``class_name: module>Class``. A name under
``tensorflow_asr.``, ``tensorflowasr_tpu.`` or ``tensorflowasr_tpu_torch.``
resolves to the port's class of that module, imported when first asked
for, so the reference's and the JAX package's configs load unmodified.
Bare names resolve as in JAX (``Conformer`` is the transducer). Every
model family of the JAX package is ported: the five transducers and the
four CTC models. The JAX package's ``register`` decorator and
``from_config`` have no caller in the port and are not copied.
"""

from __future__ import annotations

import importlib
from typing import Any

_PREFIXES = ("tensorflow_asr.", "tensorflowasr_tpu.", "tensorflowasr_tpu_torch.")
_PORT = "tensorflowasr_tpu_torch."

# module>Class (under the port's module paths) and bare names → (module, class)
_MODELS = {
    "models.transducer.conformer>Conformer": ("models.transducer.conformer", "Conformer"),
    "models.ctc.conformer>Conformer": ("models.ctc.conformer", "ConformerCtc"),
    "models.ctc.conformer>ConformerCtc": ("models.ctc.conformer", "ConformerCtc"),
    "models.ctc.transformer>Transformer": ("models.ctc.transformer", "TransformerCtc"),
    "models.ctc.transformer>TransformerCtc": ("models.ctc.transformer", "TransformerCtc"),
    "models.ctc.deepspeech2>DeepSpeech2": ("models.ctc.deepspeech2", "DeepSpeech2"),
    "models.ctc.jasper>Jasper": ("models.ctc.jasper", "Jasper"),
    "models.transducer.contextnet>ContextNet": ("models.transducer.contextnet", "ContextNet"),
    "models.transducer.rnnt>RnnTransducer": ("models.transducer.rnnt", "RnnTransducer"),
    "models.transducer.transformer>TransformerTransducer": ("models.transducer.transformer", "TransformerTransducer"),
}
_BARE = {"Conformer": "models.transducer.conformer>Conformer", "ConformerCtc": "models.ctc.conformer>ConformerCtc",
         "TransformerCtc": "models.ctc.transformer>TransformerCtc", "DeepSpeech2": "models.ctc.deepspeech2>DeepSpeech2",
         "Jasper": "models.ctc.jasper>Jasper", "ContextNet": "models.transducer.contextnet>ContextNet",
         "RnnTransducer": "models.transducer.rnnt>RnnTransducer", "TransformerTransducer": "models.transducer.transformer>TransformerTransducer"}


def _port_key(class_name: str) -> str:
    """``class_name`` with its package prefix removed (JAX ``_qualified``, for the three package names)."""
    for prefix in _PREFIXES:
        if class_name.startswith(prefix):
            return class_name[len(prefix):]
    return class_name


def get(class_name: str) -> Any:
    """The port's model class that ``class_name`` names, by ``module>Class`` or bare name."""
    key = _port_key(class_name)
    key = _BARE.get(key, key) if ">" not in key else key
    if key in _MODELS:
        module, cls = _MODELS[key]
        return getattr(importlib.import_module(_PORT + module), cls)
    raise KeyError(f"Unknown class_name {class_name!r}. Known: {sorted(_MODELS) + sorted(_BARE)}")
