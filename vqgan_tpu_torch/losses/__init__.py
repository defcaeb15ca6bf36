"""Training losses: LPIPS, the patch discriminator, GAN and VAE losses."""
