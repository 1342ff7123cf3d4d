"""The work each job needs, counted by a rule of its own, and the published peaks."""
