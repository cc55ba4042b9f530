"""Data-parallel runs over processes (``adamml_tpu/parallel/``)."""
