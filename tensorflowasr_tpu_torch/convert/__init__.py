"""Checkpoint conversion (counterpart of ``tensorflowasr_tpu/convert/``): the
reference Keras ``.weights.h5`` → the port's ``state_dict``
(``keras_h5.py``), and the JAX package's orbax checkpoints read without
orbax or tensorstore (``orbax.py``)."""

from tensorflowasr_tpu_torch.convert.keras_h5 import load_transducer_h5, read_h5_arrays  # noqa: F401
