"""Tools of the port, run as ``python -m <package>.tools.<name>``: the
training campaign driver (``train_pipeline``, ``export_latest``,
``compare_evals``) and the measurement tools."""
