"""The port's datavec (`deeplearning4j_tpu_torch/datavec/`) against the
JAX package's, on the CPU: the same records, seeds and files through both.

Records, schemas, joins and analyses are equal; DataSets (features,
labels, masks) are equal element for element; image pixels and labels
are exact, the seeded transforms drawing from the same numpy generators;
`NativeImageLoader.asMatrix` is bit-equal (both call their package's C++
bilinear resize). A masked LSTM trains on the port's ragged sequences.
"""
import numpy as np
import pytest

from deeplearning4j_tpu import datavec as J
from deeplearning4j_tpu.datavec.image_records import \
    NativeImageLoader as JLoader
from deeplearning4j_tpu_torch import datavec as T
from deeplearning4j_tpu_torch.datavec import NativeImageLoader as TLoader

LOADERS = (JLoader, TLoader)

PIL = pytest.importorskip("PIL")

CSV = """a,b,label
1.0,2.0,cat
3.0,4.0,dog
5.0,6.0,cat
"""


def _numeric_csv(rows=37, cols=6, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, cols)).round(4)
    y = rng.integers(classes, size=rows)
    return "\n".join(",".join([f"{v:g}" for v in r] + [str(int(c))])
                     for r, c in zip(x, y)) + "\n"


def _arr(a):
    return None if a is None else np.asarray(a)


def _same_ds(got, want):
    for k in ("features", "labels", "featuresMask", "labelsMask"):
        g, w = _arr(getattr(got, k, None)), _arr(getattr(want, k, None))
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _all_batches(it):
    out = []
    it.reset()
    while it.hasNext():
        out.append(it.next())
    return out


def test_csv_line_and_collection_readers_yield_the_same_records():
    for pkg_rows in ([list(P.CSVRecordReader(skipNumLines=1).initialize(
            CSV)) for P in (J, T)],
            [list(P.LineRecordReader().initialize("x\ny\n"))
             for P in (J, T)],
            [list(P.CollectionRecordReader([[1, "a"], [2, "b"]]))
             for P in (J, T)]):
        assert pkg_rows[0] == pkg_rows[1]


def test_csv_bulk_matrix_path_equals_the_jax_package(tmp_path):
    text = _numeric_csv()
    path = tmp_path / "m.csv"
    path.write_text(text)
    mats = [P.CSVRecordReader().initialize(str(path)).numeric_matrix()
            for P in (J, T)]
    np.testing.assert_array_equal(mats[1], mats[0])
    # a ragged table takes the strict record path in both
    ragged = [P.CSVRecordReader().initialize("1,2\n3\n") for P in (J, T)]
    assert [r.numeric_matrix() for r in ragged] == [None, None]
    assert list(ragged[0]) == list(ragged[1])


@pytest.mark.parametrize("mode", ["classification", "regression",
                                  "features_only", "records"])
def test_record_reader_dataset_iterator_equals_the_jax_package(mode):
    text = _numeric_csv(rows=29)
    its = []
    for P in (J, T):
        rr = P.CSVRecordReader().initialize(text)
        if mode == "records":      # the per-field path, from records
            rr = P.CollectionRecordReader(list(rr))
        kw = {"classification": dict(labelIndex=6, numClasses=4),
              "records": dict(labelIndex=6, numClasses=4),
              "regression": dict(labelIndex=0, regression=True),
              "features_only": {}}[mode]
        its.append(P.RecordReaderDataSetIterator(rr, 8, **kw))
    jb, tb = _all_batches(its[0]), _all_batches(its[1])
    assert len(jb) == len(tb) == 4
    for g, w in zip(tb, jb):
        _same_ds(g, w)
    assert its[1].totalOutcomes() == its[0].totalOutcomes()
    assert its[1].inputColumns() == its[0].inputColumns()


def _tp(P, schema):
    return (P.TransformProcess.Builder(schema)
            .filter(lambda r: float(r["v"]) < -1.5)
            .renameColumn("w", "w2")
            .doubleMathOp("v", "multiply", 2.0)
            .doubleMathOp("w2", "subtract", 0.5)
            .normalize("w2", "minmax")
            .normalize("v", "standardize")
            .stringToCategorical("s", ["p", "q"])
            .categoricalToOneHot("s")
            .categoricalToInteger("c")
            .integerToCategorical("c", ["red", "blue"])
            .removeColumns("dropme")
            .build())


def test_transform_process_equals_the_jax_package():
    rng = np.random.default_rng(1)
    rows = [[float(rng.normal()), float(rng.normal()),
             ["red", "blue"][i % 2], ["p", "q"][(i // 2) % 2], i]
            for i in range(20)]
    outs = []
    for P in (J, T):
        schema = (P.Schema.Builder().addColumnsDouble("v", "w")
                  .addColumnCategorical("c", "red", "blue")
                  .addColumnString("s").addColumnInteger("dropme").build())
        r, s = _tp(P, schema).execute([list(x) for x in rows])
        outs.append((r, s.columns))
        keep = (P.TransformProcess.Builder(schema)
                .removeAllColumnsExceptFor("w", "c").build())
        outs.append(keep.execute([list(x) for x in rows]))
    assert outs[2][0] == outs[0][0] and outs[2][1] == outs[0][1]
    assert outs[3][0] == outs[1][0]
    assert outs[3][1].columns == outs[1][1].columns


def _sequences(P):
    feats = [[[t, t + 0.5] for t in range(n)] for n in (4, 2, 3, 5)]
    labels = [[[t % 2] for t in range(n)] for n in (4, 2, 3, 5)]
    return (P.CollectionSequenceRecordReader(feats),
            P.CollectionSequenceRecordReader(labels))


@pytest.mark.parametrize("mode", ["two_readers", "align_end",
                                  "label_index", "csv_files"])
def test_sequence_iterator_equals_the_jax_package(mode, tmp_path):
    if mode == "csv_files":
        paths = []
        for i, t in enumerate((3, 5, 2)):
            p = tmp_path / f"seq{i}.csv"
            p.write_text("h1,h2,h3\n" + "\n".join(
                f"{r},{r * 10},{r % 3}" for r in range(t)))
            paths.append(str(p))
    its = []
    for P in (J, T):
        if mode == "two_readers":
            fr, lr = _sequences(P)
            it = P.SequenceRecordReaderDataSetIterator(fr, lr, batch_size=3,
                                                       numClasses=2)
        elif mode == "align_end":
            fr, _ = _sequences(P)
            lr = P.CollectionSequenceRecordReader(
                [[[1]], [[0]], [[1]], [[0]]])
            it = P.SequenceRecordReaderDataSetIterator(
                fr, lr, batch_size=2, numClasses=2,
                alignmentMode="align_end")
        elif mode == "label_index":
            fr, _ = _sequences(P)
            it = P.SequenceRecordReaderDataSetIterator(
                fr, 3, labelIndex=1, regression=True)
        else:
            rr = P.CSVSequenceRecordReader(skipNumLines=1).initialize(paths)
            it = P.SequenceRecordReaderDataSetIterator(rr, 2, labelIndex=2,
                                                       numClasses=3)
        its.append(it)
    jb, tb = _all_batches(its[0]), _all_batches(its[1])
    assert len(jb) == len(tb) >= 2
    for g, w in zip(tb, jb):
        _same_ds(g, w)


@pytest.mark.parametrize("kind", ["inner", "LeftOuter", "right_outer",
                                  "full_outer"])
def test_join_equals_the_jax_package(kind):
    outs = []
    for P in (J, T):
        left = (P.Schema.Builder().addColumnString("id")
                .addColumnDouble("x").build())
        right = (P.Schema.Builder().addColumnString("id")
                 .addColumnDouble("y").addColumnString("z").build())
        join = (P.Join.Builder(kind).setJoinColumns("id")
                .setSchemas(left, right).build())
        outs.append((join.execute(
            [["a", 1.0], ["b", 2.0], ["b", 3.0], ["d", 4.0]],
            [["b", 20.0, "u"], ["c", 30.0, "v"], ["b", 21.0, "w"]]),
            join.outSchema().columns))
    assert outs[1] == outs[0]


def test_analyze_local_equals_the_jax_package():
    rows = [[1.0, "red", "aa", 3], [-2.0, "blue", "bbbb", 0],
            [0.0, "red", "", 7], [3.0, "red", "c", -1], [None, "blue",
                                                         "dd", 2]]
    ans = []
    for P in (J, T):
        schema = (P.Schema.Builder().addColumnDouble("v")
                  .addColumnCategorical("c", "red", "blue")
                  .addColumnString("s").addColumnInteger("i").build())
        an = P.AnalyzeLocal.analyze(schema, P.CollectionRecordReader(rows))
        ans.append(({n: vars(an.getColumnAnalysis(n))
                     for n in ("v", "c", "s", "i")}, str(an)))
    assert ans[1] == ans[0]


def test_masked_lstm_trains_on_the_ports_ragged_sequences():
    from deeplearning4j_tpu_torch.nn import (LSTM, Adam, InputType,
                                             MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.recurrent import RnnOutputLayer
    fr, lr = _sequences(T)
    ds = T.SequenceRecordReaderDataSetIterator(fr, lr, batch_size=4,
                                               numClasses=2).next()
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2))
            .weightInit("xavier").list()
            .layer(LSTM(nOut=8))
            .layer(RnnOutputLayer(lossFunction="mcxent", nOut=2,
                                  activation="softmax"))
            .setInputType(InputType.recurrent(2)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    first = net.score(ds)
    for _ in range(10):
        net.fit(ds)
    assert net.score(ds) < first


# -- images -------------------------------------------------------------------
def _image_tree(root, classes=3, per=4, size=(20, 26), seed=0):
    from PIL import Image
    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(per):
            arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img_{i}.png")
    return str(root)


def _transforms(P):
    return P.PipelineImageTransform(
        P.FlipImageTransform(), (P.RandomCropTransform(14, 14), 0.7),
        (P.RotateImageTransform(15.0), 0.5),
        (P.CropImageTransform(2), 0.5), shuffle=True)


@pytest.mark.parametrize("native,transformed", [(False, False),
                                                (True, False),
                                                (True, True),
                                                (False, True)])
def test_image_record_reader_equals_the_jax_package(tmp_path, native,
                                                    transformed):
    root = _image_tree(tmp_path)
    readers = []
    for P in (J, T):
        rr = P.ImageRecordReader(
            16, 18, 3, P.ParentPathLabelGenerator(),
            imageTransform=_transforms(P) if transformed else None,
            seed=7, nativeLoader=native).initialize(root, shuffle=True)
        readers.append(rr)
    assert readers[1].getLabels() == readers[0].getLabels()
    assert readers[1].numExamples() == readers[0].numExamples() == 12
    for _ in range(2):             # a second pass continues the draws
        jr, tr = list(readers[0]), list(readers[1])
        for (ti, tl), (ji, jl) in zip(tr, jr):
            assert tl == jl and ti.shape == (16, 18, 3)
            np.testing.assert_array_equal(ti, ji)
    its = [P.ImageRecordDataSetIterator(rr, 5) for P, rr in
           zip((J, T), readers)]
    jb, tb = list(its[0]), list(its[1])
    assert [d.features.shape[0] for d in tb] == [5, 5, 2]
    for g, w in zip(tb, jb):
        _same_ds(g, w)


@pytest.mark.parametrize("name", ["resize", "flip", "crop", "rotate",
                                  "random_crop", "rgb2gray", "bgr2rgb",
                                  "rgb2hsv", "hsv2rgb", "pipeline"])
def test_image_transform_equals_the_jax_package(name):
    img = np.random.default_rng(3).integers(
        0, 256, (16, 19, 3)).astype(np.float32)

    def make(P):
        return {"resize": lambda: P.ResizeImageTransform(9, 7),
                "flip": lambda: P.FlipImageTransform(),
                "crop": lambda: P.CropImageTransform(3),
                "rotate": lambda: P.RotateImageTransform(30.0),
                "random_crop": lambda: P.RandomCropTransform(8, 11),
                "rgb2gray": lambda: P.ColorConversionTransform("RGB2GRAY"),
                "bgr2rgb": lambda: P.ColorConversionTransform("BGR2RGB"),
                "rgb2hsv": lambda: P.ColorConversionTransform("RGB2HSV"),
                "hsv2rgb": lambda: P.ColorConversionTransform("HSV2RGB"),
                "pipeline": lambda: _transforms(P)}[name]()

    outs = []
    for P in (J, T):
        t, rng = make(P), np.random.default_rng(11)
        outs.append([np.asarray(t.transform(img, rng)) for _ in range(4)])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("src", ["u8_rgb", "u8_gray_to_rgb", "rgba",
                                 "float01", "float255", "png"])
def test_native_image_loader_is_bit_equal(tmp_path, src):
    rng = np.random.default_rng(5)
    if src == "png":
        from PIL import Image
        path = tmp_path / "x.png"
        Image.fromarray(rng.integers(0, 256, (31, 23, 3), dtype=np.uint8)
                        ).save(path)
        arg = str(path)
    else:
        arg = {"u8_rgb": lambda: rng.integers(0, 256, (31, 23, 3),
                                              dtype=np.uint8),
               "u8_gray_to_rgb": lambda: rng.integers(0, 256, (31, 23),
                                                      dtype=np.uint8),
               "rgba": lambda: rng.integers(0, 256, (31, 23, 4),
                                            dtype=np.uint8),
               "float01": lambda: rng.random((31, 23, 3)).astype(
                   np.float32),
               "float255": lambda: (rng.random((31, 23, 3)) * 255).astype(
                   np.float32)}[src]()
    outs = [np.asarray(L(17, 40, 3).asMatrix(arg)) for L in LOADERS]
    assert outs[1].shape == (1, 17, 40, 3) and outs[1].dtype == np.float32
    np.testing.assert_array_equal(outs[1], outs[0])
    gray = [np.asarray(L(8, 8, 1).asMatrix(arg)) for L in LOADERS]
    np.testing.assert_array_equal(gray[1], gray[0])
