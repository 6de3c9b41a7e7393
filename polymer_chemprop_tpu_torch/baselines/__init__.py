"""Random forests and SVMs on binary features, in PyTorch, for the
``sklearn_train`` / ``sklearn_predict`` baselines (no scikit-learn):

* tree.py: CART trees grown level by level over all trees of a forest at
  once, and prediction by gathers;
* forest.py: ``RandomForestRegressor`` / ``RandomForestClassifier``;
* svm.py: RBF ``SVR`` and binary ``SVC`` with libsvm's solver and its
  Platt probabilities;
* linear.py: minimum-norm least squares for linear imputation;
* pickles.py: ``model.pkl`` in the port's format, and the JAX package's
  scikit-learn pickles read without scikit-learn.
"""
