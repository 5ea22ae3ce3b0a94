"""Checkpoint conversion: reference Keras ``.weights.h5`` → the port's ``state_dict``
(counterpart of ``tensorflowasr_tpu/convert/``)."""

from tensorflowasr_tpu_torch.convert.keras_h5 import load_transducer_h5, read_h5_arrays  # noqa: F401
