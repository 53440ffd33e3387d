"""Training: the GAN step, its optimizer, the loop and checkpoints."""
