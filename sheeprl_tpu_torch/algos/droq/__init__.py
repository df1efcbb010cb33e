"""DroQ: the dropout critic ensemble, the training run and its evaluation."""
