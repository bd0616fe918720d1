"""Training substrate of the port: optimizer, step function, checkpointing,
gradient compression, straggler watchdog (``repro.train``'s counterparts,
on one card or on a ``DeviceMesh``)."""
