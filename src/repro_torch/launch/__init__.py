"""Launchers of the port: the simulation launcher (:mod:`.simulate`),
counterpart of ``repro.launch.simulate``."""
