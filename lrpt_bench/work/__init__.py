"""The work a call needs, counted from shapes and from what its inputs
produced, whatever implements it, and the card's published peaks."""
