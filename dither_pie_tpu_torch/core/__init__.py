"""Colour and palette primitives (host numpy and device torch)."""
