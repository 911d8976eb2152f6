"""The tensor wire protocol (frames with magic, header and CRC)."""
