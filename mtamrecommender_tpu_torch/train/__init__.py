"""Training of the port: the LR schedule, the clipped Adam update and
the train step (twin of mtamrecommender_tpu/train/trainer.py, adam path)."""
