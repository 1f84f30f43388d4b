"""Host FASTA reading utilities."""

from __future__ import annotations


def iter_fasta(path: str):
    """Yield (name, seq_bytes) per record. The name is the full header
    line after '>' with the trailing newline stripped — the reference
    keeps embedded spaces (QuicKmer.c:978), so we do too."""
    name = None
    parts: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(parts)
                name = line[1:].rstrip(b"\n").decode()
                parts = []
            else:
                parts.append(line.rstrip(b"\n"))
    if name is not None:
        yield name, b"".join(parts)


def read_fasta(path: str) -> dict[str, bytes]:
    return dict(iter_fasta(path))
