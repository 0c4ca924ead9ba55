"""Training of the port: the train state and optimizer, the train step and
loop, and checkpoints (``bin_tpu/training``)."""
