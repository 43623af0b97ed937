"""The five pipeline stages as command-line programs:
remcmc -> parse -> rdf -> neural -> post."""
