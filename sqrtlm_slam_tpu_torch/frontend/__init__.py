"""ORB extraction and descriptor matching."""
