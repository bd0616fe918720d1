"""Three-term roofline of one rank's step: ``analysis.py``."""
