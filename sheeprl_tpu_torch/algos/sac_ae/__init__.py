"""SAC-AE: the pixel agent with its autoencoder, the training run and its evaluation."""
