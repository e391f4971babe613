"""Models of the sampler path: CLIP text tower, score map modules, the UNet
and the sampling engines (drift and DDPM)."""
