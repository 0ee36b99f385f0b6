"""Frozen copies of sound pieces of the port, each naming the file and the
commit it was copied from. They are never re-synced with the port."""
