"""The benchmark's yardstick: the card's data-sheet peaks and the
operations and bytes of the work each metric prices."""
