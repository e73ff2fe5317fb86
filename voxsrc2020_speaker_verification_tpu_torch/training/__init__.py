"""Training of the port: the SpeakerNet with its margin head, the train
step, the loop and checkpoints (feature-fed, single process)."""
