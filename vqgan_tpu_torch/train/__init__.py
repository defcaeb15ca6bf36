"""Train state and the GAN train step."""
