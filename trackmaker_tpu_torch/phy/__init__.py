"""Line code, encoder, the exact and speculative decoders, the streaming
PhyDecoder, the ASK modem, and the OFDM modems v1 and v2."""
