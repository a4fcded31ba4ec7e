"""Oscillators and filters of the ASK modem."""
