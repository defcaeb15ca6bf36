"""2D VAE modules."""
