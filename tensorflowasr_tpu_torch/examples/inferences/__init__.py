"""Recognize an audio file (counterparts of ``examples/inferences/*.py``):
``main`` and ``rnn_transducer`` from a config and a checkpoint (the port's
or the JAX package's orbax directory), ``program`` and
``streaming_program`` from an exported ``.pt2``. Each runs on the CUDA card
unless ``--device cpu`` is given."""
