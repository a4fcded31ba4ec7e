"""Line code, encoder, the exact and speculative decoders, the streaming
PhyDecoder, and the ASK modem."""
