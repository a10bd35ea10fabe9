"""Training of the port: schedules, state, steps, checkpoints, trainers."""
