"""Line code, encoder, the exact and speculative decoders, and the ASK modem."""
