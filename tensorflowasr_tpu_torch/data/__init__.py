"""Audio, TFRecord and manifest datasets of the port."""
