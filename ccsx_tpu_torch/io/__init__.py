"""Input readers: FASTA/Q, BAM, and group-by-hole streaming."""
