"""One module per architecture the port can run, as in ``repro.configs``:
each exports ``CONFIG`` (the published full-size config) and
``SMOKE_CONFIG`` (a reduced same-family config for CPU tests)."""
