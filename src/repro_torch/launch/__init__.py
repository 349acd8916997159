"""Launchers of the port: the simulation launcher (:mod:`.simulate`),
counterpart of ``repro.launch.simulate``, and the LM serving launcher
(:mod:`.serve`), counterpart of ``examples/serve_lm.py``."""
