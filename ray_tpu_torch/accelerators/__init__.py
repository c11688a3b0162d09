"""Accelerator facts the port needs (peak rates for MFU)."""
