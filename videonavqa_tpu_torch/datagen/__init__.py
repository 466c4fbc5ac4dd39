"""The JAX-free dataset tools the port needs: question tokenization
(``encode``) and the ontology's answer-class map (``ontology``).
"""
