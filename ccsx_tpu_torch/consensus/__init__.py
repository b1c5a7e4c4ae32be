"""Consensus layer: template pick, strand walk, star-MSA rounds."""
