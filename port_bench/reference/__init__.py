"""The plain reference of each driver and the comparison that decides ``correct``."""
