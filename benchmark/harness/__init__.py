"""What every traffic kind (`benchmark/kinds/<kind>.py`) shares: the
manifest and the files it names, the program as the cells build it, the
trace reading, the counts from shapes, and the comparisons with the plain
reference."""
