"""Seeding, logging and device selection."""
