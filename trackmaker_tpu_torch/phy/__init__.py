"""Line code, encoder, and the exact and speculative decoders."""
