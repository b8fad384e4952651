"""Capture pipeline of the port (narrow NBFM banks in this slice)."""
