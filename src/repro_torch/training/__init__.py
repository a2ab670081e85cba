"""Training: optimizers and the train-step builder, in torch."""
